"""Core HCK modules of the port (partition, factors, Algorithm 3, KRR)."""
