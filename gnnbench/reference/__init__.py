"""Plain references, one module per configuration (`reference/<config>.py`),
with what they share in `common.py`. They import nothing of the program."""
