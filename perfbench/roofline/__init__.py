"""The yardstick's counts: the H100's published peaks, each kernel's operations
and bytes from its call's shape, and each family's model FLOPs."""
