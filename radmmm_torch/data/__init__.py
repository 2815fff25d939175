"""Data path: F0 extraction, host collation and the device featurizer."""
