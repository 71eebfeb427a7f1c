"""The port's serving-layer primitives. `robustness` (deadlines,
shedding, the device circuit breaker) is here; the query coalescer is
not ported yet."""
