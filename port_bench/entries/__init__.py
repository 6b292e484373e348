"""One module a public entry point of the program that a cell's window
drives, named by the traffic file's ``entry``."""
