"""Scoring operations: Fitch (K1), the SPR scan and the insertion delta (K2)."""
