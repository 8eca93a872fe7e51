"""Attention primitives: mask tables, the sliding-chunk tier and the kernels."""
