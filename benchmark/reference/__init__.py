"""The plain PyTorch reference the benchmark's comparison holds the program
to. It imports nothing of the program."""
