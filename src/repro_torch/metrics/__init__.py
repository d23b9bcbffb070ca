from repro_torch.metrics.classification import auprc, auroc

__all__ = ["auroc", "auprc"]
