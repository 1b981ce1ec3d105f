"""The host data plane: tfrecords, tile decode and batching, the native
library, whole-slide reading; stain normalization and standardization on
torch tensors."""
