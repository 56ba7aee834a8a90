"""Tools of the port: ``convert_torch`` (reference checkpoints -> npz packs)
and the measuring entries beside ``brepgen_tpu_torch.bench``:
``bench_cascade`` (seconds per cascade batch and stage), ``train_step_bench``
(ms per edgez train step, plain against kernel attention),
``chamfer_protocol_bench`` (seconds per eval repeat) and ``io_bench`` (host
batch assembly against device train steps)."""
