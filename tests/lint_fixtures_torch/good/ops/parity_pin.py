"""Card-only parity pin for the fixture's nf::fused_fold op: on a CUDA
device, fused_fold launches the kernel and is held against
fused_fold_plain bit for bit.  (Fixture stand-in for a real test module,
marked with pytest.mark.cuda — the rule checks the pin's text names the
wrapper, the plain version and the cuda marker.)"""

PINNED = {"fused_fold": "pytest.mark.cuda parity vs fused_fold_plain"}
