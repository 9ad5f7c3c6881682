"""Stand-in for the port's parallel/: the reference runs in one process."""
