from roc_tpu_torch.fault.guard import global_norm, guarded_update

__all__ = ["global_norm", "guarded_update"]
