"""The port's twins of the JAX package's serving and dry-run tooling in
``benchmarks/``: ``roofline``, ``collective_breakdown``, ``serving_bench``."""
