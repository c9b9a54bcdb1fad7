"""Image and geometry operations on batched tensors."""
