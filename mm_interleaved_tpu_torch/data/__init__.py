"""The training data layer: copies of `mm_interleaved_tpu/data/*` that the
training entry point needs (numpy and PIL only).  Batches stay numpy; the
entry point moves them to the device."""
