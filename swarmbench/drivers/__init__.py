"""One module a way of building a cell's session, named by a configuration
file's ``driver`` key."""
