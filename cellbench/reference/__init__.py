"""The plain references: straightforward PyTorch of each configuration's
mathematics in float32 (TF32 off), which import nothing of the program and
nothing of JAX.  ``ops.Products`` carries the one switch they have: the
control, which rounds the operands of every product to TF32."""
