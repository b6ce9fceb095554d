"""Data pipeline of the port: the procedural SMMNIST dataset, the
frame-folder datasets (KTH, BAIR, Cityscapes, KITTI) on the port's own PNG
reader, the npz MovingMNIST, their transforms, the prefetching batch loader
and seeded trees in each dataset's layout."""
