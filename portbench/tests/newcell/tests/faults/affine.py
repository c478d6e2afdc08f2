"""Faults of the ``affine`` program's timed path."""


def answer_altered(monkeypatch):
    """The first value of every call's answer moved by one."""
    from portbench.families import affine

    build = affine.build_forward

    def build_forward(*args):
        forward = build(*args)

        def altered(rows):
            out = forward(rows).clone()
            out[0, 0] += 1.0
            return out

        return altered

    monkeypatch.setattr(affine, "build_forward", build_forward)
