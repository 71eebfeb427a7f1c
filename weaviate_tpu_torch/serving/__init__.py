"""The port's serving layer: `robustness` (deadlines, shedding, the device
circuit breaker), `coalescer` (cross-request query lanes over the Shard's
async search) and `controller` (the self-tuning control plane whose
recall-guarded budgets the index reads)."""
