"""The single-replica key-value store the write path folds from."""
