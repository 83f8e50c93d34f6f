"""The plain float32 reference of the benchmark: a frozen copy of the
model's mathematics (UNet, VAEs, conditioning, DDIM, the training loss,
AdamW) over the published state-dict names, with plain attention. It
imports nothing of the program."""
