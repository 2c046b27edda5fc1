"""Model entry points of the port: `matcha` (text -> mel), `hifigan` (mel -> waveform)
and `precision` (bf16 serving casts)."""
