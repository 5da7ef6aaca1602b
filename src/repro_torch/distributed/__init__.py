"""Sharding on a `torch.distributed` DeviceMesh (DTensor placements)."""
