"""The server side of the resource managers the port runs: the simulated
cluster (``base``), the slurmrestd dialect (``slurm``) and ``jaxlocal``,
whose jobs are the port's training and serving runs."""
