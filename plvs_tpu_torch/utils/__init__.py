"""Host-side utilities (stage timing)."""
