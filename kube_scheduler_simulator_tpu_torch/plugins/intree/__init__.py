"""The in-tree plugin modules, trimmed to what the encoder and the batch
engine read (constants, reason strings and shared pure helpers)."""
