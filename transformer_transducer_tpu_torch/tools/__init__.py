"""Scripts that measure the port on the card; nothing here is imported by
the package."""
