"""A frozen copy of the plain paths of the program under test, the
PyTorch port ``locov_torch``: its config tree, models, ops, box algebra
and optimizer as they stood when the benchmark was written, with every
hand-written kernel taken out (``ops/kernel_lib.py`` launches nothing;
each ``torch.library`` op runs its plain version on every device, under
the namespace ``locov_ref``). The plain ROIAlign takes its boxes 16 at a
time rather than 200, so that its float32 intermediates fit beside a
batch of 32 on one card: the same sums in blocks. It imports nothing of the program, so a
later change to the program leaves this yardstick as it is.
"""
