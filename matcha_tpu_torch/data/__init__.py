"""Training data: length-bucketed, statically padded batches (numpy)."""
