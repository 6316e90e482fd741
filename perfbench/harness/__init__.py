"""The benchmark's general machinery: finding a cell's files by name
(`cells`), making its frames from the seed (`frames`), the device trace
and its reduction (`trace`), the per-layer metric readers (`metrics`), the
comparison with the plain reference that decides `correct` (`check`), the
program and control runs the limits are read from (`control`) and the
result line (`cli`)."""
