"""Network modules of the port: text encoder, decoder U-Net, transformer block, RoPE."""
