"""Native host code of the port (see :mod:`.lib`)."""
