"""Scoring operations: Fitch (K1), the SPR scan, the insertion delta (K2),
likelihoods (K3/K4; the model fits, partitioned too), pairwise distances,
exact Sankoff parsimony (K5), the strict clock (``ops.clock``) and the
samplers' device NNI moves and rescoring (``ops.tree_moves``,
``ops.nni_scan``)."""
