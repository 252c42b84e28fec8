"""`python -m jepsen_tpu_torch watch ...` and `... serve --daemon ...`."""

from .cli import main, serve_cmd, watch_cmd

if __name__ == "__main__":
    main({**serve_cmd(), **watch_cmd()})
