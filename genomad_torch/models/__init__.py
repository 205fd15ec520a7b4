"""Models of the port: the IGLOO window classifier and its weights."""
