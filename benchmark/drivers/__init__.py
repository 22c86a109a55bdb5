"""The drivers a traffic mix names: each sets the program up and runs its window."""
