"""Data generators: the balanced mutation-tree ground truth."""
