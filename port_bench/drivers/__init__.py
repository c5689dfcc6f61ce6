"""One module per kind of work a traffic file can ask for; the traffic
file's ``driver`` key names it."""
