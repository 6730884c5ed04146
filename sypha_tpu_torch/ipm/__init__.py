"""Shared-matrix batched Mehrotra IPM and B&B node batches."""
