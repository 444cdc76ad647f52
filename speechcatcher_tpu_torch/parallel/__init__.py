"""Multi-card parallelism: device meshes, sharding rules, tensor-parallel
collectives, the sharded serving engine and a rank launcher."""
