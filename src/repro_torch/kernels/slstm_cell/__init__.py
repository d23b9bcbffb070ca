"""Stabilized sLSTM cell kernel (port of ``src/repro/kernels/slstm_cell``)."""
