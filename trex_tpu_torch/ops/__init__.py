"""Scoring operations: Fitch (K1), the SPR scan, the insertion delta (K2),
likelihoods (K3/K4) and exact Sankoff parsimony (K5)."""
