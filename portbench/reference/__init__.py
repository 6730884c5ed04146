"""Plain references and the comparisons that decide ``correct``; nothing
here imports the program."""
