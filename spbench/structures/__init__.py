"""Generators of the configurations' matrices and graphs, on the device
from a seed."""
