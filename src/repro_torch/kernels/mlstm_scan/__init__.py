"""Chunkwise mLSTM / SSD scan kernel (port of ``src/repro/kernels/mlstm_scan``)."""
