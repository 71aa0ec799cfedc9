"""The plain references that decide ``correct``: one model a file
(``<model>.py``), built from its configuration's numbers alone, and the
checks of committed plans (``plans.py``).  Nothing here imports the
program."""
