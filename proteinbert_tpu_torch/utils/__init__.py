"""Host-side utilities of the port: `h5` (HDF5 helpers, a copy of the JAX
package's)."""
