"""Plain PyTorch references for the output checks. They import nothing of
the program and take nothing it made: only the inputs the check draws
from the seed."""
