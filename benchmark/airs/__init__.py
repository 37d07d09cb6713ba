"""The program's side of each AIR a configuration can name: airs/<air name>.py,
found by the harness by that name."""
