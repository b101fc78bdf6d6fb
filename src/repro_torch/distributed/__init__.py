"""Distributed pieces of the port: int8 compression, the device mesh with
its logical sharding rules, parameter partitioning and the mesh-sharded
serve tier's placement (DESIGN.md S3)."""
