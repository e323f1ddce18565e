"""The benchmark's yardstick: manifests, device checks, weights and traffic
made from the seed, the adapter to the system under test, the trace
reduction, the work counts and the correctness comparison."""
