"""`python -m jepsen_tpu_torch watch ...`, `... serve --daemon ...`,
`... doctor ...` and `... fuzz ...`."""

from .cli import doctor_cmd, fuzz_cmd, main, serve_cmd, watch_cmd

if __name__ == "__main__":
    main({**serve_cmd(), **watch_cmd(), **doctor_cmd(), **fuzz_cmd()})
