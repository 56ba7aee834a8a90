"""Tools of the port: ``convert_torch`` (reference checkpoints -> npz packs)."""
