"""Service lifecycle and bit arrays (cometbft_tpu/libs)."""
