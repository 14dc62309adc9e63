"""Scripts of the port: measurements on the card, checkpoint tools and the
tone corpus writer; nothing here is imported by the package."""
