"""Math/sampling library as plain torch functions, batched over
leading dimensions (port of merian_quake_tpu/ops)."""
