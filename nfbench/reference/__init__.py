"""The plain reference of the world tick, in plain PyTorch.

It imports nothing of the program under test (nor JAX): its inputs are
tensors keyed by the state's leaf paths (``"classes.NPC.i32"``, every leaf
with a leading room axis), a :class:`~nfbench.reference.tick.Layout` that
names the columns it reads, and the deployment's frozen geometry from the
configuration file.  :func:`~nfbench.reference.tick.step` advances every
room one tick; :func:`~nfbench.reference.build.initial_rooms` builds the
deployment's start state from the inputs the benchmark drew.

Arithmetic is float32 where the program is float32, TF32 off; the float
rounding rules it follows (one fused multiply-add for ``a*b + c`` where the
game's reference compiler contracts it, a correctly rounded square root,
``x / c`` as ``x * float32(1 / c)``) are in :mod:`.arith`.  ``fdt`` lowers
the float work to another dtype: the control of the correctness check runs
it in bfloat16.
"""
