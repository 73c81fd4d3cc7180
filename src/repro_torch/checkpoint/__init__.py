"""Weight interchange of the port."""
