"""Scripts of the port: measurements on the card and checkpoint tools;
nothing here is imported by the package."""
