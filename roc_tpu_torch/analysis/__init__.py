"""The port's static and runtime checks (roc_tpu/analysis/, the parts that
apply to a PyTorch tree):

* :mod:`roc_tpu_torch.analysis.lint`: roclint, an AST lint for hazards that
  never change a value (timed syncs, syncs on the serving path, raw timing
  windows, out-of-ledger predictions, swallowed errors, ad-hoc
  recomputation, unpinned stream buffers, legacy RNG, Python traps);
* :mod:`roc_tpu_torch.analysis.threads`: the lock-discipline analyzer and
  its committed baseline ``threads.json``;
* :mod:`roc_tpu_torch.analysis.witness`: the runtime lock-order witness
  that checks real acquisitions against that baseline.

roc_tpu's ``hlo_audit``, ``mosaic`` and ``retrace`` read XLA and Mosaic
artifacts, which the port does not have; they are not ported.  Importing
this package loads nothing.
"""
