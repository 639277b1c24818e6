"""Host runtime of the port: the native KITTI loader and prefetcher."""
