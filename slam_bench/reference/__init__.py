"""The plain reference that decides a run's ``correct``: NumPy, SciPy and
plain PyTorch only. It imports nothing of the program under test and works
out again, from the inputs the benchmark made, everything it compares."""
