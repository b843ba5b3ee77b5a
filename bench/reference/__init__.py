"""The plain reference: the models and the training step in plain PyTorch
(fp32, TF32 off), written from the published descriptions and the
BitDistill paper.  It imports neither JAX, nor the JAX package, nor
anything of the program (``repro_torch``), and takes nothing the program
made: it works the ternary weights, the int8 activations and the
optimizer's state out again from the benchmark's master weights and
inputs."""
