"""In-memory data sources of the port."""
