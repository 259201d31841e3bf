"""Model pieces of the port that the graph slice needs: the reference
chains (``chains``) and the dense layer's torch twin (``transformer``).
The models slice ports the rest of the reference's ``models`` package."""
