"""Command-line tools of the port (counterparts of chord_tpu's tools/).

proto_paged_tex     the paged-texture prototype: palette sampler (kernel K10)
                    against a numpy oracle, and its time
repro_eval_kernel   the shadow-evaluate fault bisection, 22 variants; the
                    `tm_pallas` variant runs the fusion barrier (kernel K9)

Each runs on the card (`python3 -m chord_tpu_torch.tools.<name>`) unless
it is asked for the CPU.
"""
