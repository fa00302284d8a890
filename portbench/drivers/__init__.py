"""One module per entry of the port that a cell drives (README.md)."""
