"""The benchmark's plain reference: the port's plain PyTorch path, frozen
(no kernel, no import of the program), and `track.Reference`, which
recomputes and judges one tracker frame."""
