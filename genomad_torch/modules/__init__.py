"""Pipeline modules of the port."""
