"""Binary bag-of-words vocabulary (place recognition)."""
