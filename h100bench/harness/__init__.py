"""The benchmark's machinery: finding a cell's files by name, making its
weights and traffic from the seed, driving the port's entry points,
tracing, the metric readers and the correctness comparison."""
