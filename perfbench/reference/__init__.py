"""Plain PyTorch references, one file each, named by a configuration's
``reference``. They import nothing of the program."""
