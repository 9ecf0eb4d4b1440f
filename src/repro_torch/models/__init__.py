"""The LM stack: layers, GQA attention over the flash/paged kernels, the
dense decoder, and the conversion of the JAX package's parameter trees."""
