"""Service lifecycle, bit arrays, the native build, and the verify path's
reports: metrics, trace, log, devstats and the accelerator probe
(cometbft_tpu/libs)."""
