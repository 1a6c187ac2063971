"""Tree search: stepwise addition and hill climbing."""
