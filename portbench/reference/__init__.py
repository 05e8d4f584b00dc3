"""Plain PyTorch / NumPy reference of the path tracer and its present
step. Imports nothing of the system under test, of `jax`, or of the JAX
package."""
