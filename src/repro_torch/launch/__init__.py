"""Launch drivers of the port (serving)."""
