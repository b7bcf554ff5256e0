"""Online-softmax (flash) attention kernel for Hopper, with GQA head mapping."""
