"""The references of the programs, one file each, found by the program's
name: ``reference/programs/<name>.py`` gives ``Reference`` and ``Control``
and may give its own ``state_of`` (README.md, "A reference file")."""
