"""The plain reference the benchmark judges the program's listings by.

It imports nothing of the program: torch, numpy and the standard library
only."""
