from roc_tpu_torch.optim.adam import Adam, AdamState

__all__ = ["Adam", "AdamState"]
