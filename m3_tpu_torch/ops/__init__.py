"""Kernel wrappers, their plain PyTorch versions, and the host oracles.

Same tensor contract as the reference package: a batch of series is
``[lanes, time]`` with int64 unix-nano timestamps, float64 values and a
bool validity mask; a compressed batch is ``[lanes, words]`` uint32
bitstreams plus int32 per-lane bit lengths.
"""
