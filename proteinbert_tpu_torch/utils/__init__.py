"""Host-side utilities of the port: `h5` (HDF5 helpers), `sharding` (ETL
task-array index math) and `stats` (BH, Fisher, one-hot), copies of the
JAX package's; `logging` and `profiling`."""
