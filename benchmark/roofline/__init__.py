"""The yardstick's arithmetic: the H100's published peaks, each hand-written
kernel's operations and bytes by call shape, and the model FLOPs behind the
``mfu`` metrics. Each input byte is counted read once and each output byte
written once, whatever a kernel reads again."""
