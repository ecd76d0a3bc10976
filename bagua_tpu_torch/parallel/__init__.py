"""Model parallelism: ring attention (sequence parallel) and the dense
layers of tensor parallelism."""
