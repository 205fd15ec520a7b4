"""One driver per entry point of the port; a configuration names its entry."""
