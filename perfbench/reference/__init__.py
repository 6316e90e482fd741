"""The plain reference: the unified BlazeFace + head-pose model, its
preprocess and its postprocess in plain PyTorch and NumPy (float32, TF32
off).  It is built from a configuration's spec and the shipped weights file
alone and imports nothing of the program under test."""
