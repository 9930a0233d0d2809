"""One module a kind of traffic: ``run(cell, seed, seconds, trace, device,
t_start)`` sets the cell up, measures for ``seconds``, checks what the
timed path produced and returns a ``harness.Run``."""
