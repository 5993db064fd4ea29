"""The data-parallel runtime (mesh, cross-replica BN, the dry run),
optimizers and the train / eval steps."""
