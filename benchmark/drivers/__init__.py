"""One driver a traffic kind: the general generator that reads a traffic
file of that kind and runs the program under it."""
