"""The recipes of the traffic generator, one file per kind of traffic."""
