"""Operation and byte counts of the work the cells run, op by op, from the
shapes of these inputs, and the peaks they are scored against."""
