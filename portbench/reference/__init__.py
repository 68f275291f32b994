"""Plain references of the configurations, found by the name a
configuration gives under ``reference``. They import nothing of the
program and take nothing the program made."""
