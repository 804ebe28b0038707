"""The plain references: PyTorch f32 (TF32 off), written from the
published equations; nothing of the program is imported."""
