"""Plain references the benchmark judges the program by; they import
nothing of the program."""
